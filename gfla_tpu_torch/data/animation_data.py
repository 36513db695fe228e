"""Video data for the animation heads (counterpart of gfla_tpu/data/
animation_data.py:59-147, 489-516): the sequence sampling the file-backed
datasets share, and the synthetic clips.

A sample is time-major numpy, as gfla_tpu's: P_all (T, H, W, 3) frames in
[-1, 1], BP_all (T, H, W, structure_nc) skeleton maps, ref_image and
ref_skeleton (H, W, ...), and gen_paths, the T frames' names. T is
`--n_frames_total` in training and `--n_frames_pre_load_test` at test time.
The task's `prepare_batch` moves a collated batch to the device as
(B, T, C, H, W). The file-backed DanceDataset and FaceDataset are not ported
yet (ROADMAP.md, queue 1).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


class AnimationDatasetBase:
    """Window sampling and the test cursor (animation_data.py:59-112)."""

    def __init__(self, opt):
        self.opt = opt
        self.is_train = getattr(opt, "isTrain", True) and opt.phase == "train"
        ls = opt.load_size
        self.load_size = (ls, ls) if isinstance(ls, int) else tuple(ls)
        self.n_frames_total = (
            opt.n_frames_total if self.is_train else opt.n_frames_pre_load_test
        )
        self.rng = np.random.RandomState(getattr(opt, "seed", 0) or None)
        self.seq_idx = 0
        self.frame_idx = getattr(opt, "start_frame", 0)

    def sample_window(self, seq_len: int) -> Tuple[int, int, int]:
        """(n_frames, start, t_step): a random window with a random stride in
        training (the original's animation_dataset.py:77-102), the cursor's
        next chunk at test time."""
        opt = self.opt
        if self.is_train:
            n_total = min(self.n_frames_total, seq_len)
            per_load = min(opt.max_frames_per_gpu, n_total)
            n_total = per_load * (n_total // per_load)
            max_t_step = max(1, min(opt.max_t_step,
                                    seq_len // max(1, n_total)))
            t_step = self.rng.randint(max_t_step) + 1
            offset_max = max(1, seq_len - (n_total - 1) * t_step)
            start = self.rng.randint(offset_max)
            return n_total, start, t_step
        return self.n_frames_total, self.frame_idx, 1

    def advance_test_cursor(self, seq_count: int) -> bool:
        """Move the (sequence, frame) cursor one chunk on; True when that
        leaves the sequence (`change_seq`)."""
        self.frame_idx += self.opt.n_frames_pre_load_test
        change_seq = self.frame_idx >= seq_count
        if change_seq:
            self.seq_idx += 1
            self.frame_idx = getattr(self.opt, "start_frame", 0)
        return change_seq


class SyntheticVideoDataset(AnimationDatasetBase):
    """Eight deterministic clips: sample i is drawn from RandomState(i), so
    both packages yield identical arrays."""

    def __init__(self, opt):
        super().__init__(opt)
        self.n = 8
        self.nc = opt.structure_nc

    @staticmethod
    def apply_defaults(opt, is_train: bool):
        opt.image_nc = 3
        if getattr(opt, "old_size", None) is None:
            opt.old_size = opt.load_size
        return opt

    def __len__(self):
        return self.n

    def __getitem__(self, index: int) -> Dict:
        H, W = self.load_size
        T = self.n_frames_total
        rng = np.random.RandomState(index)
        return {
            "P_all": (rng.rand(T, H, W, 3).astype(np.float32) * 2 - 1),
            "BP_all": rng.rand(T, H, W, self.nc).astype(np.float32),
            "ref_image": (rng.rand(H, W, 3).astype(np.float32) * 2 - 1),
            "ref_skeleton": rng.rand(H, W, self.nc).astype(np.float32),
            "gen_paths": [f"syn_{index}_{t}.png" for t in range(T)],
        }
