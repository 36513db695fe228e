"""Human3.6M 2-D pose datasets of the keypoint head, the Motion Extraction
Net (counterpart of gfla_tpu/data/keypoint_data.py; the original's
keypoint_dataset.py and keypointtest_dataset.py).

- KeypointDataset: detector-vs-ground-truth VideoPose3D NPZ pairs
  (`--input_path`, `--gt_path`), each joint normalised to [-1, 1] over its
  camera's width; subjects S9 and S11 are held out of training and are the
  test split. A training sample is a random window of `--n_frames_pre_load`
  gt frames and the input frames around it, padded by the receptive field
  (`--n_receptive`) with the indices clamped to the sequence, both scaled
  and shifted by one augmentation draw.
- KeypointTestDataset: the OpenPose-18 JSONs of real videos under
  `{dataroot}/{phase}_alphapose/<sequence>/`, converted to COCO-17, a whole
  sequence a sample, edge-padded by half the receptive field; a frame with
  no person gives zeros.
Layout: (T, 34) float32, channels [y0..y16, x0..x16] (the original's
(2, 17) -> view order, keypoint_dataset.py:124-135). Numpy on the host; the
task moves the arrays to its device.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from gfla_tpu_torch.data import human36m, openpose_utils
from gfla_tpu_torch.data.animation_data import make_grouped_dataset

GT_PATH = "./dataset/human36m/data_2d_h36m_gt.npz"
INPUT_PATH = "./dataset/human36m/data_2d_h36m_detectron_pt_coco.npz"


def _normalize_2d(data: np.ndarray, res_w: int) -> np.ndarray:
    """(T, 17, 2) (x, y) pixels -> (T, 34) in [-1, 1], [y..., x...]."""
    d = data / res_w * 2 - 1
    d = d[:, :, ::-1]                       # (x, y) -> (y, x)
    d = np.transpose(d, (0, 2, 1))          # (T, 2, 17)
    return d.reshape(d.shape[0], -1).astype(np.float32)


class KeypointDataset:
    @staticmethod
    def modify_options(parser, is_train: bool):
        """The dataset's flags (keypoint_dataset.py:20-38)."""
        parser.add_argument("--t_step", type=int, default=1)
        parser.add_argument("--n_receptive", type=int, default=81)
        parser.add_argument("--gt_path", type=str, default=GT_PATH)
        parser.add_argument("--input_path", type=str, default=INPUT_PATH)
        return parser

    @staticmethod
    def apply_defaults(opt, is_train: bool):
        opt.structure_nc = 17
        for key, value in (("t_step", 1), ("n_frames_pre_load", 24),
                           ("n_receptive", 81), ("gt_path", GT_PATH),
                           ("input_path", INPUT_PATH)):
            if not hasattr(opt, key):
                setattr(opt, key, value)
        return opt

    def __init__(self, opt):
        self.opt = opt
        self.is_train = getattr(opt, "isTrain", True) and opt.phase == "train"
        self.gt_data, self.gt_type = human36m.init_position_data(opt.gt_path)
        self.input_data, self.input_type = \
            human36m.init_position_data(opt.input_path)
        self.cameras = human36m.init_cameras_param()
        exclude = ["S9", "S11"] if self.is_train else \
            ["S1", "S5", "S6", "S7", "S8"]
        self.data_list = human36m.init_video_list(
            opt.input_path, opt.gt_path, exclude)
        self.data_list = human36m.check_dataset(
            self.gt_data, self.input_data, self.data_list, self.gt_type)
        # unseeded at --seed 0, as in gfla_tpu; the loader's workers reseed
        self.rng = np.random.RandomState(getattr(opt, "seed", 0) or None)

    def __len__(self):
        return len(self.data_list)

    def __getitem__(self, index: int) -> Dict:
        opt = self.opt
        seq = self.data_list[index % len(self.data_list)]
        inp = self.input_data[seq["subject"]][seq["action"]][seq["camera"]]
        if "detectron_pt_coco" in opt.input_path:
            inp = inp[:, :, :-1]  # the detector's score channel
        gt = self.gt_data[seq["subject"]][seq["action"]][seq["camera"]]
        gt = gt[:, :, :2]
        n = min(inp.shape[0], gt.shape[0])
        inp, gt = inp[:n], gt[:n]
        cam = self.cameras[seq["subject"]][int(seq["camera"])]

        if not self.is_train:
            return {
                "input_data": _normalize_2d(inp, cam["res_w"]),
                "gt_data": _normalize_2d(gt, cam["res_w"]),
                "out_path": f"{seq['subject']}_{seq['action']}_"
                            f"{seq['camera']}",
            }

        # a random window, the input padded by the receptive field
        # (keypoint_dataset.py:53-80)
        P, R = opt.n_frames_pre_load, opt.n_receptive
        t_step = max(1, min(opt.t_step, n // P))
        start = self.rng.randint(max(1, n - (P - 1) * t_step))
        gt_idx = [start + i * t_step for i in range(P)]
        in_idx = [int(np.clip(start + i * t_step, 0, n - 1))
                  for i in range(-R // 2 + 1, P + R // 2)]
        inp_w = _normalize_2d(inp[in_idx], cam["res_w"])
        gt_w = _normalize_2d(gt[gt_idx], cam["res_w"])

        # the scale and shift augmentation (keypoint_dataset.py:137-150)
        scale = 0.5 * self.rng.random_sample() + 1.0
        dy = self.rng.random_sample() * 0.2 - 0.1
        dx = self.rng.random_sample() * 0.2 - 0.1
        delta = np.concatenate(
            [np.full(17, dy, np.float32), np.full(17, dx, np.float32)])
        return {"input_data": inp_w * scale + delta,
                "gt_data": gt_w * scale + delta}


class KeypointTestDataset:
    """Real videos' skeleton JSONs streamed through the denoiser, a whole
    sequence a sample (keypointtest_dataset.py)."""

    @staticmethod
    def apply_defaults(opt, is_train: bool):
        opt.structure_nc = 17
        for key, value in (("n_receptive", 81), ("n_frames_pre_load", 24)):
            if not hasattr(opt, key):
                setattr(opt, key, value)
        return opt

    def __init__(self, opt):
        self.opt = opt
        self.seqs = make_grouped_dataset(
            os.path.join(opt.dataroot, opt.phase + "_alphapose"))
        ls = opt.load_size
        self.load_size = (ls, ls) if isinstance(ls, int) else tuple(ls)

    def __len__(self):
        return len(self.seqs)

    def _kp(self, path: str) -> np.ndarray:
        """One OpenPose-18 JSON -> (34,) COCO-17 [y..., x...] in [-1, 1]
        over the width; zeros when the frame has no person."""
        with open(path) as f:
            people = json.load(f)["people"]
        if not people:
            return np.zeros(34, np.float32)
        pose = openpose_utils.obtain_2d_cords(people[0])["body"]
        pose = openpose_utils.openpose18_to_coco17(pose)
        kp = 2 * pose.astype(np.float32) / self.load_size[1] - 1
        return kp.reshape(-1)

    def __getitem__(self, index: int) -> Dict:
        paths = self.seqs[index]
        R = self.opt.n_receptive
        kps = np.stack([self._kp(p) for p in paths])  # (T, 34)
        pad_front = np.repeat(kps[:1], R // 2, axis=0)
        pad_back = np.repeat(kps[-1:], R // 2, axis=0)
        return {"input_data": np.concatenate([pad_front, kps, pad_back]),
                "gen_paths": list(paths)}
