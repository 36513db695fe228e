"""Video data for the animation heads (counterpart of gfla_tpu/data/
animation_data.py:40-516): the sequence sampling the datasets share, the
file-backed DanceDataset (iPER and FashionVideo, skeleton JSONs) and
FaceDataset (FaceForensics, 68-point landmark txt files), and the
synthetic clips.

T is `--n_frames_total` in training and `--n_frames_pre_load_test` at test
time. The file-backed samples carry the frames' JPEG bytes, not pixels, as
the pose datasets do (data/paired_dataset.py): the decode, the warp-resize
and what needs the pixels run on the task's device (tasks/animation.py
`prepare_batch`). Their keys:
- P_all, the T frames' bytes (a list of uint8 1-D arrays), and P_all_inv
  (T, 2, 3) float32, each frame's inverse affine matrix (the identity
  without augmentation);
- dance: ref_image (bytes) and ref_inv, the reference drawn from the
  sequence's first 20 frames; with --use_mask (iPER, training) mask_all,
  the T frames' `train_C` masks' bytes (PNG or JPEG), and mask_inv
  (T, 2, 3) float64, the matrix of PIL's transform of each; with the
  device encode (training, the default) KP_all (T, 17, 2) float32 (y, x)
  at the loaded size, 0 where missing, BP_all_rgb (T, H, W, 3) uint8, the
  drawn limbs, and ref_KP, ref_rgb for the reference; else (test time,
  --no_device_encode) BP_all (T, H, W, 20) and ref_skeleton (H, W, 20)
  float32, the 17 heatmaps and the limbs in [0, 1]; at test time also
  gen_kps_clean and gen_kps_noise (34, T), the normalised joints;
- face: edges (T, H, W) uint8, the landmark curves (0 or 255); dist
  (T, H, W, 14) int16, each part's city-block distance to its curve,
  clipped at 765 (absent with --no_dist_map); labels (T, H, W) uint8, the
  part labels (0-6) resized to the loaded size. The Canny background joins
  the edges on the device. The reference is the first frame;
- gen_paths, the T frames' paths; at test time frame_idx, the cursor after
  the chunk, and change_seq, True on a sequence's last chunk.
The synthetic clips are arrays in gfla_tpu's layout: P_all (T, H, W, 3) in
[-1, 1], BP_all (T, H, W, structure_nc), ref_image, ref_skeleton.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np

from gfla_tpu_torch.data import openpose_utils
from gfla_tpu_torch.data.affine import image_inverse
from gfla_tpu_torch.data.image_io import jpeg_size
from gfla_tpu_torch.data.keypoint2img import draw_edge, interp_points
from gfla_tpu_torch.data.raster import (
    distance_l1,
    fill_poly,
    resize_nearest,
)

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")
IDENTITY = np.array([[1, 0, 0], [0, 1, 0]], np.float32)
DIST_MAX = 765  # clip(dist / 3, 0, 255) saturates from here


def make_grouped_dataset(root: str) -> List[List[str]]:
    """Each subdirectory of `root` is one sequence: its image, JSON, txt
    and npy files, sorted."""
    groups = []
    if not os.path.isdir(root):
        return groups
    for d in sorted(os.listdir(root)):
        sub = os.path.join(root, d)
        if not os.path.isdir(sub):
            continue
        files = sorted(
            os.path.join(sub, f) for f in os.listdir(sub)
            if f.lower().endswith(IMG_EXTS + (".json", ".txt", ".npy")))
        if files:
            groups.append(files)
    return groups


def pad_to_multiple(paths: List[str], chunk: int) -> List[str]:
    """The last path repeated until the count is a multiple of chunk."""
    if len(paths) % chunk:
        paths = paths + [paths[-1]] * (chunk - len(paths) % chunk)
    return paths


def read_bytes(path: str) -> np.ndarray:
    return np.fromfile(path, np.uint8)


def _read_json(path: str):
    with open(path) as f:
        return json.load(f)


class AnimationDatasetBase:
    """Window sampling, the test cursor and the augmentation draws
    (animation_data.py:59-147). gfla_tpu keeps the test cursor in the
    dataset and moves it a chunk at each call; here chunk i's (sequence,
    first frame) is looked up from i, which gives the same order when the
    loader asks for 0, 1, 2, ... and stays right in the loader's worker
    processes. The augmentation RandomState is unseeded at --seed 0, as in
    gfla_tpu."""

    def __init__(self, opt):
        self.opt = opt
        self.is_train = getattr(opt, "isTrain", True) and opt.phase == "train"
        ls = opt.load_size
        self.load_size = (ls, ls) if isinstance(ls, int) else tuple(ls)
        self.n_frames_total = (
            opt.n_frames_total if self.is_train else opt.n_frames_pre_load_test
        )
        self.rng = np.random.RandomState(getattr(opt, "seed", 0) or None)

    def index_sequences(self, counts: List[int]) -> None:
        """The test cursor's chunks: (sequence, first frame), each
        sequence from --start_frame in steps of --n_frames_pre_load_test
        until the frame count (padded to the step) is reached."""
        step = self.opt.n_frames_pre_load_test
        start = getattr(self.opt, "start_frame", 0)
        self.chunks = []
        for seq, count in enumerate(counts):
            frame = start
            while True:
                self.chunks.append((seq, frame))
                frame += step
                if frame >= count:
                    break

    def __len__(self):
        return len(self.sequences) if self.is_train else len(self.chunks)

    def sample_window(self, seq_len: int) -> Tuple[int, int, int]:
        """(n_frames, start, t_step) of a training window: a random start
        and a random stride (the original's animation_dataset.py:77-102)."""
        opt = self.opt
        n_total = min(self.n_frames_total, seq_len)
        per_load = min(opt.max_frames_per_gpu, n_total)
        n_total = per_load * (n_total // per_load)
        max_t_step = max(1, min(opt.max_t_step, seq_len // max(1, n_total)))
        t_step = self.rng.randint(max_t_step) + 1
        offset_max = max(1, seq_len - (n_total - 1) * t_step)
        start = self.rng.randint(offset_max)
        return n_total, start, t_step

    def window(self, index: int) -> Tuple[int, int, int, int]:
        """(sequence, n_frames, start, t_step): sample_window over the
        index's sequence in training, the index's chunk at test time."""
        if not self.is_train:
            seq, start = self.chunks[index]
            return seq, self.n_frames_total, start, 1
        seq = index % len(self.sequences)
        return (seq, *self.sample_window(len(self.sequences[seq])))

    def cursor(self, out: Dict, seq: int, start: int) -> Dict:
        """frame_idx and change_seq of a test chunk, as gfla_tpu's cursor
        reports them."""
        if not self.is_train:
            out["frame_idx"] = start + self.opt.n_frames_pre_load_test
            out["change_seq"] = out["frame_idx"] >= len(self.sequences[seq])
        return out

    def random_affine(self):
        """angle, then scale, then the two shifts, each drawn where its range
        is set, in training only; None otherwise."""
        opt = self.opt
        angle = getattr(opt, "angle", None)
        shift = getattr(opt, "shift", None)
        scale = getattr(opt, "scale", None)
        if not (angle or shift or scale) or not self.is_train:
            return None
        return {
            "angle": self.rng.uniform(*angle) if angle else 0.0,
            "scale": self.rng.uniform(*scale) if scale else 1.0,
            "shift": (
                self.rng.uniform(-shift[0], shift[0]) if shift else 0.0,
                self.rng.uniform(-shift[1], shift[1]) if shift else 0.0,
            ),
        }

    def inverse(self, affine) -> np.ndarray:
        """The 2x3 inverse matrix of an affine draw, in output pixels,
        float32 (the frames' warp-resize)."""
        return image_inverse(self.load_size, affine).astype(np.float32)


class DanceDataset(AnimationDatasetBase):
    """FashionVideo and iPER person animation (dance_dataset.py of the
    original; gfla_tpu/data/animation_data.py:149-382): `{phase}_256/
    train_A/<seq>/` frames, `train_video2d/` the clean Human3.6M-17
    skeletons that drive the generator, `train_alphapose/` the OpenPose-18
    ones of the reference; with --use_mask, `train_C/` the iPER person
    masks, read only for --sub_dataset=iper in training, as gfla_tpu reads
    them (silently ignored otherwise)."""

    @staticmethod
    def modify_options(parser, is_train: bool):
        """The dataset's flags (dance_dataset.py:22-68)."""
        parser.add_argument("--sub_dataset", type=str, default="iper",
                            help="iper | fashion")
        parser.add_argument("--no_bone_map", action="store_true",
                            default=False)
        parser.add_argument("--use_kp", action="store_true", default=False)
        parser.add_argument("--total_test_frames", type=int, default=None)
        parser.add_argument("--test_list", type=str, default=None)
        parser.add_argument("--cross_eval", action="store_true",
                            default=False)
        parser.add_argument(
            "--no_device_encode", action="store_true", default=False,
            help="ship full 20-channel structure maps from the loader "
            "instead of (17,2) coords + limb RGB with the Gaussian "
            "heatmaps encoded on device (device encode cuts host->HBM "
            "transfer 3.4x and loader CPU ~2x; numerically identical)")
        return parser

    @staticmethod
    def apply_defaults(opt, is_train: bool):
        opt.load_size = getattr(opt, "load_size", 256) or 256
        opt.structure_nc = 17 + 3
        opt.image_nc = 3
        if getattr(opt, "old_size", None) is None:
            opt.old_size = opt.load_size
        sub = getattr(opt, "sub_dataset", "iper")
        if is_train:
            if sub == "fashion":
                opt.angle = getattr(opt, "angle", None) or (-5, 5)
                opt.shift = getattr(opt, "shift", None) or (20, 3)
                opt.scale = getattr(opt, "scale", None) or (0.98, 1.02)
            else:
                opt.angle = getattr(opt, "angle", None) or (-5, 5)
        return opt

    def __init__(self, opt):
        super().__init__(opt)
        self.sub_dataset = getattr(opt, "sub_dataset", "iper")
        self.use_mask = bool(getattr(opt, "use_mask", False)) \
            and self.sub_dataset == "iper" and self.is_train
        self.device_encode = self.is_train and \
            not getattr(opt, "no_device_encode", False)
        base = os.path.join(opt.dataroot, opt.phase + "_256")
        self.sequences = make_grouped_dataset(os.path.join(base, "train_A"))
        self.clean = make_grouped_dataset(os.path.join(base, "train_video2d"))
        self.noise = make_grouped_dataset(
            os.path.join(base, "train_alphapose"))
        self.masks = make_grouped_dataset(os.path.join(base, "train_C")) \
            if self.use_mask else None
        if not self.is_train:
            chunk = opt.n_frames_pre_load_test
            self.sequences, self.clean, self.noise = (
                [pad_to_multiple(p, chunk) for p in group]
                for group in (self.sequences, self.clean, self.noise))
            self.index_sequences([len(p) for p in self.sequences])

    def _pose(self, path, affine, org_size, is_clean):
        """A skeleton JSON -> (2, 17) (y, x) at the loaded size, or None
        when the frame has no person."""
        people = _read_json(path)["people"]
        if not people:
            return None
        pose = openpose_utils.obtain_2d_cords(
            people[0], resize_param=self.load_size, org_size=org_size,
            affine=affine)["body"]
        if not is_clean:
            pose = openpose_utils.openpose18_to_coco17(pose)
        return pose

    def _limbs(self, pose, is_clean) -> np.ndarray:
        """(2, 17) or None -> (H, W, 3) uint8, the drawn limbs."""
        color = np.zeros((*self.load_size, 3), np.uint8)
        if pose is not None:
            limbs = (openpose_utils.LIMB_SEQ_HUMAN36M_17 if is_clean
                     else openpose_utils.LIMB_SEQ_COCO_17)
            openpose_utils.draw_joint(color, pose.astype(int), limbs)
        return color

    def _maps(self, pose, is_clean) -> np.ndarray:
        """(2, 17) or None -> (H, W, 20) float32: heatmaps, then limbs."""
        if pose is None:
            return np.zeros((*self.load_size, self.opt.structure_nc),
                            np.float32)
        return np.concatenate(
            [openpose_utils.obtain_map(pose, self.load_size),
             self._limbs(pose, is_clean).astype(np.float32) / 255.0], -1)

    @staticmethod
    def _kp(pose) -> np.ndarray:
        """(2, 17) or None -> (17, 2) float32, MISSING_VALUE when absent."""
        if pose is None:
            return np.full((17, 2), openpose_utils.MISSING_VALUE, np.float32)
        return pose.T.astype(np.float32)

    def _norm_kp(self, pose) -> np.ndarray:
        """(2, 17) or None -> (34, 1) float32 in [-1, 1], zeros when absent
        (the y row then the x row, over the width)."""
        if pose is None:
            return np.zeros((34, 1), np.float32)
        kp = pose.astype(np.float32).reshape(34, 1)
        return 2 * kp / self.load_size[1] - 1

    def __getitem__(self, index: int) -> Dict:
        affine = self.random_affine()
        seq, n_frames, start, t_step = self.window(index)
        frames = self.sequences[seq]
        org_size = jpeg_size(read_bytes(frames[0]))
        idxs = [min(start + i * t_step, len(frames) - 1)
                for i in range(n_frames)]
        poses = [self._pose(self.clean[seq][i], affine, org_size, True)
                 for i in idxs]
        out = {"P_all": [read_bytes(frames[i]) for i in idxs],
               "P_all_inv": np.stack([self.inverse(affine)] * n_frames),
               "gen_paths": [frames[i] for i in idxs]}
        if self.device_encode:
            out["KP_all"] = np.stack([self._kp(p) for p in poses])
            out["BP_all_rgb"] = np.stack([self._limbs(p, True)
                                          for p in poses])
        else:
            out["BP_all"] = np.stack([self._maps(p, True) for p in poses])
        if self.use_mask:
            out["mask_all"] = [read_bytes(self.masks[seq][i]) for i in idxs]
            out["mask_inv"] = np.stack(
                [image_inverse(self.load_size, affine)] * n_frames)
        if not self.is_train:
            out["gen_kps_clean"] = np.concatenate(
                [self._norm_kp(p) for p in poses], axis=1)
            out["gen_kps_noise"] = np.concatenate(
                [self._norm_kp(self._pose(self.noise[seq][i], affine,
                                          org_size, False))
                 for i in idxs], axis=1)
        # the reference: one of the first 20 frames (dance_dataset.py:
        # 158-169), under its own augmentation draw for fashion
        if self.sub_dataset == "fashion":
            affine = self.random_affine()
        ridx = self.rng.randint(len(frames[:20]))
        ref_pose = self._pose(self.noise[seq][ridx], affine, org_size, False)
        out.update(ref_image=read_bytes(frames[ridx]),
                   ref_inv=self.inverse(affine), ref_path=frames[ridx])
        if self.device_encode:
            out["ref_KP"] = self._kp(ref_pose)
            out["ref_rgb"] = self._limbs(ref_pose, False)
        else:
            out["ref_skeleton"] = self._maps(ref_pose, False)
        return self.cursor(out, seq, start)


class FaceDataset(AnimationDatasetBase):
    """FaceForensics face animation (face_dataset.py of the original;
    gfla_tpu/data/animation_data.py:385-487): `{phase}_data/<seq>/` frames
    and `{phase}_keypoints/<seq>/` 68-point landmark txt files."""

    @staticmethod
    def modify_options(parser, is_train: bool):
        parser.add_argument("--no_canny_edge", action="store_true",
                            default=False)
        parser.add_argument("--no_dist_map", action="store_true",
                            default=False)
        parser.add_argument("--total_test_frames", type=int, default=None)
        return parser

    # facial part polylines over the 83 keypoints (68 + mirrored upper face)
    PART_LIST = [
        [list(range(0, 17)) + list(range(68, 83)) + [0]],
        [list(range(17, 22))],
        [list(range(22, 27))],
        [[28, 31], list(range(31, 36)), [35, 28]],
        [[36, 37, 38, 39], [39, 40, 41, 36]],
        [[42, 43, 44, 45], [45, 46, 47, 42]],
        [list(range(48, 55)), [54, 55, 56, 57, 58, 59, 48]],
        [list(range(60, 65)), [64, 65, 66, 67, 60]],
    ]
    PART_LABELS = [1, 2, 2, 3, 4, 4, 5, 6]

    @staticmethod
    def apply_defaults(opt, is_train: bool):
        opt.load_size = getattr(opt, "load_size", 256) or 256
        opt.structure_nc = 16
        opt.image_nc = 3
        if getattr(opt, "old_size", None) is None:
            opt.old_size = opt.load_size
        return opt

    def __init__(self, opt):
        super().__init__(opt)
        root = opt.dataroot
        # the landmark files count the frames, as in gfla_tpu
        self.sequences = make_grouped_dataset(
            os.path.join(root, opt.phase + "_keypoints"))
        self.frames = make_grouped_dataset(
            os.path.join(root, opt.phase + "_data"))
        if not self.is_train:
            chunk = opt.n_frames_pre_load_test
            self.sequences = [pad_to_multiple(p, chunk)
                              for p in self.sequences]
            self.frames = [pad_to_multiple(p, chunk) for p in self.frames]
            self.index_sequences([len(p) for p in self.sequences])

    def structure(self, kp_path: str, size: Tuple[int, int]):
        """68-point landmarks of a frame of `size` (h, w) -> the curves
        (H, W) uint8, the 14 parts' distances (H, W, 14) int16 (None with
        --no_dist_map) and the part labels (H, W) uint8, at the loaded size
        (face_dataset.py:143-229 of the original)."""
        H, W = self.load_size
        h, w = size
        keypoints = np.loadtxt(kp_path, delimiter=",")
        # the upper face, mirrored (face_dataset.py:181-185)
        pts = keypoints[:17, :].astype(np.int32)
        baseline_y = (pts[0, 1] + pts[-1, 1]) / 2
        upper = pts[1:-1, :].copy()
        upper[:, 1] = baseline_y + (baseline_y - upper[:, 1]) * 2 // 3
        keypoints = np.vstack((keypoints, upper[::-1, :]))

        part_labels = np.zeros((h, w), np.uint8)
        for p, edge_list in enumerate(self.PART_LIST):
            indices = [i for sub in edge_list for i in sub]
            fill_poly(part_labels, keypoints[indices].astype(np.int32),
                      self.PART_LABELS[p])

        no_dist = getattr(self.opt, "no_dist_map", False)
        im_edges = np.zeros((H, W), np.uint8)
        dists = []
        for edge_list in self.PART_LIST:
            for edge in edge_list:
                im_edge = np.zeros((H, W), np.uint8)
                for i in range(0, max(1, len(edge) - 1), 2):
                    sub = list(edge[i:i + 3])
                    x = keypoints[sub, 0].astype(np.float32) / w * W
                    y = keypoints[sub, 1].astype(np.float32) / h * H
                    cx, cy = interp_points(x.astype(int), y.astype(int))
                    draw_edge(im_edges, cx, cy, bw=0)
                    draw_edge(im_edge, cx, cy, bw=0)
                if not no_dist:
                    dist = distance_l1(255 - im_edge)
                    dists.append(np.minimum(dist, DIST_MAX).astype(np.int16))
        labels = resize_nearest(part_labels, (W, H))
        return im_edges, None if no_dist else np.stack(dists, -1), labels

    def __getitem__(self, index: int) -> Dict:
        seq, n_frames, start, t_step = self.window(index)
        kps, frames = self.sequences[seq], self.frames[seq]
        idxs = [min(start + i * t_step, len(kps) - 1)
                for i in range(n_frames)]
        datas = [read_bytes(frames[i]) for i in idxs]
        parts = [self.structure(kps[i], jpeg_size(d))
                 for i, d in zip(idxs, datas)]
        out = {"P_all": datas, "P_all_inv": np.stack([IDENTITY] * n_frames),
               "edges": np.stack([p[0] for p in parts]),
               "labels": np.stack([p[2] for p in parts]),
               "gen_paths": [frames[i] for i in idxs]}
        if parts[0][1] is not None:
            out["dist"] = np.stack([p[1] for p in parts])
        return self.cursor(out, seq, start)


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
