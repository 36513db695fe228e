"""The file-backed pose datasets, DeepFashion and Market-1501 (counterpart
of gfla_tpu/data/paired_dataset.py:42-169): the pairs CSV, the
':'-separated keypoint annotations, per-image random affine augmentation
(the target's damped x0.2 / x0.5 / 1) and the keypoints moved with it.

A sample carries the image file's JPEG bytes, not pixels: `__getitem__` runs
in the loader's worker processes, and the decode and the warp-resize happen
on the task's device in one batched pass (tasks/pose.py `prepare_batch`,
through data/image_io.py and data/resample.py). Keys: P1 and P2 (the bytes,
uint8 1-D), P1_inv and P2_inv (each image's 2x3 inverse matrix, float32,
the identity without augmentation), KP1 and KP2 (the keypoints at the
loaded size, (K, 2) float32 (y, x), -1 where missing), P1_path and P2_path.
The CSVs are read with the csv module; no pandas.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Tuple

import numpy as np

from gfla_tpu_torch.data.affine import (
    forward_affine_matrix,
    inverse_affine_matrix,
    random_affine_params,
)
from gfla_tpu_torch.data.pose_utils import (
    load_pose_cords_from_strings,
    transform_cords,
)

IDENTITY = np.array([[1, 0, 0], [0, 1, 0]], np.float32)


def _as_hw(size) -> Tuple[int, int]:
    return (size, size) if isinstance(size, int) else tuple(size)


def _read_csv(path: str, delimiter: str = ","):
    with open(path, newline="") as f:
        return list(csv.DictReader(f, delimiter=delimiter))


class PairedKeypointDataset:
    """Base paired dataset; subclasses give the file names (get_paths)."""

    def __init__(self, opt):
        self.opt = opt
        self.phase = opt.phase
        self.load_size = _as_hw(opt.load_size)
        self.old_size = _as_hw(opt.old_size)
        self.angle = getattr(opt, "angle", None) or None
        self.shift = getattr(opt, "shift", None) or None
        self.scale = getattr(opt, "scale", None) or None
        self.image_dir, bone_file, self.name_pairs = self.get_paths(opt)
        self._ann = {row["name"]: row
                     for row in _read_csv(bone_file, delimiter=":")}
        # gfla_tpu's seeding (paired_dataset.py:57-59): --seed, else 0
        # outside train and an unseeded draw in train
        self.rng = np.random.RandomState(
            getattr(opt, "seed", None) or (0 if opt.phase != "train" else None))

    def get_paths(self, opt):
        raise NotImplementedError

    def __len__(self):
        return len(self.name_pairs)

    def _keypoints(self, name: str) -> np.ndarray:
        row = self._ann[name]
        return load_pose_cords_from_strings(row["keypoints_y"],
                                            row["keypoints_x"])

    def _one_side(self, name: str, damp: bool):
        angle, shift, scale = random_affine_params(
            self.rng, self.angle, self.shift, self.scale)
        if damp:  # the target's augmentation is damped
            angle, shift, scale = angle * 0.2, (shift[0] * 0.5,
                                                shift[1] * 0.5), 1.0
        H, W = self.load_size
        matrix, inv = None, IDENTITY
        if self.angle or self.shift or self.scale:
            center = (W * 0.5 + 0.5, H * 0.5 + 0.5)
            matrix = forward_affine_matrix(center, angle, shift, scale)
            inv = np.asarray(inverse_affine_matrix(center, angle, shift,
                                                   scale),
                             np.float32).reshape(2, 3)
        with open(os.path.join(self.image_dir, name), "rb") as f:
            data = np.frombuffer(f.read(), np.uint8)
        kp = transform_cords(self._keypoints(name), self.load_size,
                             self.old_size, matrix)
        return data, inv, kp.astype(np.float32)

    def __getitem__(self, index: int) -> Dict:
        p1_name, p2_name = self.name_pairs[index]
        p1, inv1, kp1 = self._one_side(p1_name, damp=False)
        p2, inv2, kp2 = self._one_side(p2_name, damp=True)
        return {"P1": p1, "P1_inv": inv1, "KP1": kp1,
                "P2": p2, "P2_inv": inv2, "KP2": kp2,
                "P1_path": p1_name, "P2_path": p2_name}


def _pairs(root: str, prefix: str, phase: str):
    rows = _read_csv(os.path.join(root, f"{prefix}-pairs-{phase}.csv"))
    return (os.path.join(root, phase),
            os.path.join(root, f"{prefix}-annotation-{phase}.csv"),
            [(row["from"], row["to"]) for row in rows])


class FashionDataset(PairedKeypointDataset):
    """DeepFashion: `fasion-pairs-{phase}.csv`, `fasion-annotation-
    {phase}.csv` and the images under `{phase}/`; load 256, keypoints
    annotated at (256, 176)."""

    @staticmethod
    def apply_defaults(opt, is_train: bool):
        opt.load_size = getattr(opt, "load_size", 256) or 256
        opt.old_size = (256, 176)
        opt.structure_nc = 18
        opt.image_nc = 3
        return opt

    def get_paths(self, opt):
        return _pairs(opt.dataroot, "fasion", opt.phase)


class MarketDataset(PairedKeypointDataset):
    """Market-1501: `market-pairs-{phase}.csv` and the rest as DeepFashion's;
    128x64, with affine augmentation in training."""

    @staticmethod
    def apply_defaults(opt, is_train: bool):
        opt.load_size = (128, 64)
        opt.old_size = (128, 64)
        opt.structure_nc = 18
        opt.image_nc = 3
        if is_train:
            # per field: overriding one range, or --angle=False, leaves the
            # other two at their defaults
            if getattr(opt, "angle", None) is None:
                opt.angle = (-5, 5)
            if getattr(opt, "shift", None) is None:
                opt.shift = (-5, 5)
            if getattr(opt, "scale", None) is None:
                opt.scale = (0.95, 1.05)
        return opt

    def get_paths(self, opt):
        return _pairs(opt.dataroot, "market", opt.phase)
