"""The ShapeNet novel-view dataset, an HDF5 image and pose store
(counterpart of gfla_tpu/data/shapenet_data.py, the original's
data/shapenet_dataset.py).

Store layout under `--dataroot`: `data_{model}.hdf5` holds one group per
view, `{object}_{azimuth / 10}_{elevation slot}`, with `image` (H, W, 3
uint8) and `pose` (2,) = (azimuth / 10, elevation); `id_{model}_{phase}.txt`
lists the views of the phase and `name_{model}_test.txt` the test objects.

A training sample is a view and the same object at a random azimuth drawn
from the dataset's `rng` (which the loader reseeds in each worker); a test
sample is view `index % 18` of a test object and the object's whole sweep of
18 azimuths as targets: P2 (18, H, W, 3), BP2 (18, 2) and 18 P2_path. The
images are the stored uint8 pixels: the resize to `--load_size` and the
[-1, 1] scaling happen on the task's device (tasks/pose.py `prepare_batch`,
data/resample.py `resize_like_pil`). The labels stay raw ints; the task
one-hots them on the device (tasks/shapenet.py `labels_to_semantic`).
The store is read through the port's own HDF5 reader (data/hdf5.py: numpy
and zlib, no h5py, which the card's Python lacks), opened lazily in each
worker, since an open file does not pickle.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from gfla_tpu_torch.data import hdf5


def _rgb(img: np.ndarray) -> np.ndarray:
    """PIL's convert("RGB") of a grey or RGBA uint8 array."""
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    return img[..., :3]


class ShapeNetDataset:
    @staticmethod
    def modify_options(parser, is_train: bool):
        """The dataset's flags (gfla_tpu/data/shapenet_data.py:20-27)."""
        parser.add_argument("--ang_skip", type=int, default=20)
        parser.add_argument("--label_nc_h", type=int, default=18)
        parser.add_argument("--label_nc_v", type=int, default=3)
        parser.add_argument("--sub_dataset_model", type=str, default="car")
        return parser

    @staticmethod
    def apply_defaults(opt, is_train: bool):
        opt.load_size = getattr(opt, "load_size", 256) or 256
        opt.structure_nc = 18 + 3
        opt.image_nc = 3
        if getattr(opt, "old_size", None) is None:
            opt.old_size = opt.load_size
        for name, value in (("ang_skip", 20), ("label_nc_h", 18),
                            ("label_nc_v", 3), ("sub_dataset_model", "car")):
            if not hasattr(opt, name):
                setattr(opt, name, value)
        return opt

    def __init__(self, opt):
        self.is_train = getattr(opt, "isTrain", True) and opt.phase == "train"
        root = opt.dataroot
        phase = "test" if opt.phase == "val" else opt.phase
        model = getattr(opt, "sub_dataset_model", "car")
        self.hdf5_file = os.path.join(root, f"data_{model}.hdf5")
        # atleast_1d: genfromtxt makes a one-line file 0-d
        self.image_ids = np.atleast_1d(np.genfromtxt(
            os.path.join(root, f"id_{model}_{phase}.txt"), dtype=str))
        self.image_names = None if self.is_train else np.atleast_1d(
            np.genfromtxt(os.path.join(root, f"name_{model}_{phase}.txt"),
                          dtype=str))
        self.angle_list = list(range(0, 360, getattr(opt, "ang_skip", 20)))
        self._h5 = None
        self.rng = np.random.RandomState(None if self.is_train else 5)

    def __getstate__(self):
        return dict(self.__dict__, _h5=None)  # each worker opens its own

    def _data(self):
        if self._h5 is None:
            self._h5 = hdf5.File(self.hdf5_file)
        return self._h5

    def _image(self, key: str) -> np.ndarray:
        return _rgb(np.uint8(self._data()[key]["image"][()]))

    def _pose(self, key: str) -> np.ndarray:
        return np.asarray(self._data()[key]["pose"][()], np.int32).reshape(-1)

    def __len__(self):
        return len(self.image_ids if self.is_train else self.image_names)

    def __getitem__(self, index: int) -> Dict:
        if self.is_train:
            source_id = str(self.image_ids[index])
            target_angle = int(self.rng.choice(self.angle_list) / 10)
            parts = source_id.split("_")
            target_id = "_".join([parts[0], str(target_angle), parts[-1]])
            return {"P1": self._image(source_id),
                    "P2": self._image(target_id),
                    "BP1": self._pose(source_id),
                    "BP2": self._pose(target_id),
                    "P1_path": source_id, "P2_path": target_id}
        name = str(self.image_names[index])
        h_angle = int(self.angle_list[index % len(self.angle_list)] / 10)
        source_id = f"{name}_{h_angle}_0"
        targets = [f"{name}_{int(a / 10)}_0" for a in self.angle_list]
        return {"P1": self._image(source_id),
                "BP1": self._pose(source_id),
                "P2": np.stack([self._image(t) for t in targets]),
                "BP2": np.array([[int(a / 10), 0] for a in self.angle_list],
                                np.int32),
                "P1_path": source_id, "P2_path": targets}
