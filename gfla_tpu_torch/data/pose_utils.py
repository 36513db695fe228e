"""Keypoints of the pose datasets: the annotation strings, their mapping
onto the loaded image and host heatmaps (numpy twins of
gfla_tpu/data/pose_utils.py:28-100), Gaussian heatmaps on the device (torch
twin of :102-123), the skeleton drawing (:126-173) and Market-1501's body
mask for mask-LPIPS (:176-206). gfla_tpu draws with cv2; the port draws with
data/raster.py's copies of cv2's primitives, bit for bit, and closes the
mask with its own 5x5 morphology."""

from __future__ import annotations

import json
from typing import Optional, Tuple

import numpy as np
import torch

from gfla_tpu_torch.data.raster import circle_filled, fill_poly, line_aa

MISSING_VALUE = -1

# OpenPose-18 limb pairs and joint colours (the original's pose_utils.py)
LIMB_SEQ = [
    [1, 2], [1, 5], [2, 3], [3, 4], [5, 6], [6, 7], [1, 8], [8, 9],
    [9, 10], [1, 11], [11, 12], [12, 13], [1, 0], [0, 14], [14, 16],
    [0, 15], [15, 17], [2, 16], [5, 17],
]
COLORS = [
    [255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0], [170, 255, 0],
    [85, 255, 0], [0, 255, 0], [0, 255, 85], [0, 255, 170], [0, 255, 255],
    [0, 170, 255], [0, 85, 255], [0, 0, 255], [85, 0, 255], [170, 0, 255],
    [255, 0, 255], [255, 0, 170], [255, 0, 85],
]
LABELS = [
    "nose", "neck", "Rsho", "Relb", "Rwri", "Lsho", "Lelb", "Lwri",
    "Rhip", "Rkne", "Rank", "Lhip", "Lkne", "Lank", "Leye", "Reye",
    "Lear", "Rear",
]
# the body mask's limbs, 1-based as in the original
MASK_LIMBS = np.array([
    [2, 3], [2, 6], [3, 4], [4, 5], [6, 7], [7, 8], [2, 9], [9, 10],
    [10, 11], [2, 12], [12, 13], [13, 14], [2, 1], [1, 15], [15, 17],
    [1, 16], [16, 18], [2, 17], [2, 18], [9, 12], [12, 6], [9, 3],
    [17, 18],
]) - 1


def load_pose_cords_from_strings(y_str: str, x_str: str) -> np.ndarray:
    """The annotation CSV's keypoint strings -> (K, 2) array of (y, x)."""
    y = json.loads(y_str)
    x = json.loads(x_str)
    return np.stack([np.asarray(y), np.asarray(x)], axis=1)


def transform_cords(cords: np.ndarray, img_size: Tuple[int, int],
                    old_size: Optional[Tuple[int, int]] = None,
                    affine_matrix: Optional[np.ndarray] = None) -> np.ndarray:
    """Rescale (y, x) keypoints from old_size to img_size and apply the
    forward 3x3 affine, truncating to int as gfla_tpu does; joints at
    MISSING_VALUE stay there."""
    old_size = img_size if old_size is None else old_size
    out = np.full_like(cords, MISSING_VALUE, dtype=np.float32)
    for i, point in enumerate(cords.astype(float)):
        if point[0] == MISSING_VALUE or point[1] == MISSING_VALUE:
            continue
        y = point[0] / old_size[0] * img_size[0]
        x = point[1] / old_size[1] * img_size[1]
        if affine_matrix is not None:
            p = affine_matrix @ np.array([x, y, 1.0])
            y, x = int(p[1]), int(p[0])
        else:
            y, x = int(y), int(x)
        out[i] = (y, x)
    return out


def encode_heatmaps(cords: torch.Tensor, height: int, width: int,
                    sigma: float = 6.0,
                    missing_value: float = MISSING_VALUE,
                    row0: int = 0) -> torch.Tensor:
    """cords (..., K, 2) as (y, x), `missing_value` for absent joints ->
    heatmaps (..., H, W, K) on cords' device; absent joints give zero maps.
    The `height` rows are the map's rows from `row0` (a row band's, from its
    global coordinates)."""
    y = cords[..., 0]
    x = cords[..., 1]
    yy = torch.arange(row0, row0 + height, dtype=torch.float32,
                      device=cords.device)
    xx = torch.arange(width, dtype=torch.float32, device=cords.device)
    dy2 = (yy[:, None] - y[..., None, :]) ** 2      # (..., H, K)
    dx2 = (xx[:, None] - x[..., None, :]) ** 2      # (..., W, K)
    maps = torch.exp(-(dy2[..., :, None, :] + dx2[..., None, :, :])
                     / (2.0 * sigma**2))            # (..., H, W, K)
    present = (y != missing_value) & (x != missing_value)
    return maps * present[..., None, None, :]


def cords_to_map(cords: np.ndarray, img_size: Tuple[int, int],
                 old_size: Optional[Tuple[int, int]] = None,
                 affine_matrix: Optional[np.ndarray] = None,
                 sigma: float = 6.0) -> np.ndarray:
    """Host Gaussian heatmaps (H, W, K), float32."""
    t = transform_cords(cords, img_size, old_size, affine_matrix)
    H, W = img_size
    result = np.zeros((H, W, cords.shape[0]), np.float32)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    for i, (y, x) in enumerate(t):
        if y == MISSING_VALUE or x == MISSING_VALUE:
            continue
        result[..., i] = np.exp(-((yy - y) ** 2 + (xx - x) ** 2)
                                / (2 * sigma**2))
    return result


def draw_pose_from_cords(pose_joints: np.ndarray, img_size: Tuple[int, int],
                         radius: int = 2, draw_joints: bool = True
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """The skeleton of (K, 2) (y, x) joints as a uint8 (H, W, 3) image and
    its bool (H, W) coverage: each limb an anti-aliased grey line, each
    joint a filled circle in its colour."""
    colors = np.zeros(tuple(img_size) + (3,), np.uint8)
    mask = np.zeros(img_size, bool)
    pts = pose_joints.astype(int)
    if draw_joints:
        for f, t in LIMB_SEQ:
            if (pts[f] == MISSING_VALUE).any() or \
                    (pts[t] == MISSING_VALUE).any():
                continue
            line = line_aa(np.zeros(img_size, np.uint8),
                           (pts[f][1], pts[f][0]), (pts[t][1], pts[t][0]),
                           255)
            sel = line > 0
            colors[sel] = line[sel][:, None]
            mask |= sel
    for i, joint in enumerate(pts):
        if (joint == MISSING_VALUE).any():
            continue
        circ = circle_filled(np.zeros(img_size, np.uint8),
                             (joint[1], joint[0]), radius, 255)
        sel = circ > 0
        colors[sel] = COLORS[i]
        mask |= sel
    return colors, mask


def map_to_cord(pose_map: np.ndarray, threshold: float = 0.1) -> np.ndarray:
    """Heatmaps (H, W, K) -> (K, 2) (y, x) of each map's first maximum,
    MISSING_VALUE where the maximum is at most `threshold`."""
    K = min(18, pose_map.shape[-1])
    out = np.full((K, 2), MISSING_VALUE, np.int64)
    for i in range(K):
        m = pose_map[..., i]
        if m.max() > threshold:
            out[i] = np.unravel_index(np.argmax(m), m.shape)
    return out


def draw_pose_from_map(pose_map: np.ndarray, threshold: float = 0.1,
                       **kwargs):
    return draw_pose_from_cords(map_to_cord(pose_map, threshold),
                                pose_map.shape[:2], **kwargs)


def _window(img: np.ndarray, k: int, pad_value: int, reduce) -> np.ndarray:
    """`reduce` (np.max or np.min) over each pixel's k x k neighbourhood,
    the outside padded with `pad_value`, which takes no part."""
    r = k // 2
    padded = np.pad(img, r, constant_values=pad_value)
    return reduce(np.lib.stride_tricks.sliding_window_view(padded, (k, k)),
                  axis=(-2, -1))


def morph_close(mask: np.ndarray, k: int = 5) -> np.ndarray:
    """cv2.morphologyEx(mask, cv2.MORPH_CLOSE, np.ones((k, k), np.uint8)) on
    a uint8 image: a dilation, then an erosion, each with cv2's default
    border, outside the image taking part in neither."""
    dilated = _window(mask, k, 0, np.max)
    return _window(dilated, k, 255, np.min)


def produce_ma_mask(kp_array: np.ndarray, img_size: Tuple[int, int],
                    point_radius: int = 4) -> np.ndarray:
    """Market-1501's body mask from (18, 2) (y, x) keypoints: each limb of
    MASK_LIMBS a filled quadrilateral `point_radius` wide on each side,
    each joint a filled circle, then a 5x5 closing; bool (H, W)."""
    mask = np.zeros(img_size, np.uint8)
    kp = kp_array.astype(float)
    for f, t in MASK_LIMBS:
        if (kp[f] == MISSING_VALUE).any() or (kp[t] == MISSING_VALUE).any():
            continue
        n = kp[f] - kp[t]
        n = np.array([-n[1], n[0]])
        norm = np.linalg.norm(n)
        if norm == 0:
            continue
        n = point_radius * n / norm
        poly = np.array([kp[f] + n, kp[f] - n, kp[t] - n, kp[t] + n])
        fill_poly(mask, poly[:, ::-1].astype(np.int32), 1)
    for joint in kp:
        if (joint == MISSING_VALUE).any():
            continue
        circle_filled(mask, (int(joint[1]), int(joint[0])), point_radius, 1)
    return morph_close(mask).astype(bool)
