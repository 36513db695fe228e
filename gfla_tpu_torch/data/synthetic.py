"""Deterministic synthetic paired pose data (numpy twin of gfla_tpu's
SyntheticPoseDataset, gfla_tpu/data/paired_dataset.py:180-216): sample i is
drawn from RandomState(i), so both packages yield identical arrays."""

from __future__ import annotations

from typing import Dict

import numpy as np

from gfla_tpu_torch.data.pose_utils import MISSING_VALUE


def _as_hw(size):
    return (size, size) if isinstance(size, int) else tuple(size)


class SyntheticPoseDataset:
    def __init__(self, opt):
        self.load_size = _as_hw(getattr(opt, "load_size", 64))
        self.n = getattr(opt, "max_dataset_size", 64)
        if self.n > 10_000:
            self.n = 64
        self.structure_nc = getattr(opt, "structure_nc", 18)

    @staticmethod
    def apply_defaults(opt, is_train: bool):
        opt.structure_nc = getattr(opt, "structure_nc", 18) or 18
        opt.image_nc = 3
        if getattr(opt, "old_size", None) is None:
            opt.old_size = opt.load_size
        return opt

    def __len__(self):
        return self.n

    def __getitem__(self, index: int) -> Dict:
        H, W = self.load_size
        rng = np.random.RandomState(index)
        kp = rng.rand(2, self.structure_nc, 2).astype(np.float32)
        kp[..., 0] *= H - 1
        kp[..., 1] *= W - 1
        kp[:, -2:, :] = MISSING_VALUE  # exercise missing-joint handling
        return {
            "P1": (rng.rand(H, W, 3).astype(np.float32) * 2 - 1),
            "KP1": kp[0],
            "P2": (rng.rand(H, W, 3).astype(np.float32) * 2 - 1),
            "KP2": kp[1],
            "P1_path": f"syn_{index}_a.jpg",
            "P2_path": f"syn_{index}_b.jpg",
        }

