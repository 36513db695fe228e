"""OpenPose, COCO and Human3.6M skeletons of the dance dataset (numpy
counterpart of gfla_tpu/data/openpose_utils.py:19-195): the format tables
and limb sequences, the JSON person's coordinates rescaled and moved by the
augmentation, Gaussian heatmaps, the drawn limbs (on data/raster.py, the
port's copy of the cv2 calls) and the 18/25 -> COCO-17 conversions.
Coordinates are (y, x) rows of a (2, K) array. MISSING_VALUE is 0, not the
pose datasets' -1: OpenPose writes 0 for an undetected joint, so a joint
whose coordinate is 0 counts as missing.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from gfla_tpu_torch.data.affine import forward_affine_matrix
from gfla_tpu_torch.data.raster import (
    circle_filled,
    circle_outline,
    line_aa,
    line_thick,
)

MISSING_VALUE = 0

LIMB_SEQ_25 = [
    [1, 2], [1, 5], [2, 3], [3, 4], [5, 6], [6, 7], [1, 8],
    [8, 9], [9, 10], [10, 11], [11, 24], [11, 22], [22, 23],
    [8, 12], [12, 13], [13, 14], [14, 21], [14, 19], [19, 20],
    [1, 0], [0, 16], [16, 18], [0, 15], [15, 17],
]
LIMB_SEQ_18 = [
    [1, 2], [1, 5], [2, 3], [3, 4], [5, 6], [6, 7], [1, 8],
    [8, 9], [9, 10], [1, 11], [11, 12], [12, 13],
    [1, 0], [0, 14], [14, 16], [0, 15], [15, 17],
]
HAND_SEQ = [
    [0, 1], [1, 2], [2, 3], [3, 4], [0, 5], [5, 6], [6, 7], [7, 8],
    [0, 9], [9, 10], [10, 11], [11, 12], [0, 13], [13, 14], [14, 15],
    [15, 16], [0, 17], [17, 18], [18, 19], [19, 20],
]
LIMB_SEQ_HUMAN36M_17 = [
    [0, 1], [1, 2], [2, 3], [0, 4], [4, 5], [5, 6], [0, 7], [7, 8],
    [8, 9], [9, 10], [8, 11], [11, 12], [12, 13], [8, 14], [14, 15],
    [15, 16],
]
LIMB_SEQ_COCO_17 = [
    [0, 1], [1, 3], [0, 2], [2, 4], [5, 7], [7, 9], [6, 8], [8, 10],
    [11, 12], [5, 6], [11, 13], [12, 14], [13, 15], [14, 16], [5, 11],
    [6, 12],
]

OPENPOSE_25 = {
    "Nose": 0, "Neck": 1, "RShoulder": 2, "RElbow": 3, "RWrist": 4,
    "LShoulder": 5, "LElbow": 6, "LWrist": 7, "MidHip": 8, "RHip": 9,
    "RKnee": 10, "RAnkle": 11, "LHip": 12, "LKnee": 13, "LAnkle": 14,
    "REye": 15, "LEye": 16, "REar": 17, "LEar": 18, "LBigToe": 19,
    "LSmallToe": 20, "LHeel": 21, "RBigToe": 22, "RSmallToe": 23,
    "RHeel": 24,
}
OPENPOSE_18 = {
    "Nose": 0, "Neck": 1, "RShoulder": 2, "RElbow": 3, "RWrist": 4,
    "LShoulder": 5, "LElbow": 6, "LWrist": 7, "RHip": 8, "RKnee": 9,
    "RAnkle": 10, "LHip": 11, "LKnee": 12, "LAnkle": 13, "REye": 14,
    "LEye": 15, "REar": 16, "LEar": 17,
}
COCO_17 = {
    "Nose": 0, "LEye": 1, "REye": 2, "LEar": 3, "REar": 4,
    "LShoulder": 5, "RShoulder": 6, "LElbow": 7, "RElbow": 8,
    "LWrist": 9, "RWrist": 10, "LHip": 11, "RHip": 12, "LKnee": 13,
    "RKnee": 14, "LAnkle": 15, "RAnkle": 16,
}
HUMAN36M_17 = {
    "Hip": 0, "RHip": 1, "RKnee": 2, "RFoot": 3, "LHip": 4, "LKnee": 5,
    "LFoot": 6, "Spine": 7, "Thorax": 8, "Neck/Nose": 9, "Head": 10,
    "LShoulder": 11, "LElbow": 12, "LWrist": 13, "RShoulder": 14,
    "RElbow": 15, "RWrist": 16,
}


def labelcolormap(n: int) -> np.ndarray:
    if n == 18:
        return np.array([
            [255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0],
            [170, 255, 0], [85, 255, 0], [0, 255, 0], [0, 255, 85],
            [0, 255, 170], [0, 255, 255], [0, 170, 255], [0, 85, 255],
            [0, 0, 255], [85, 0, 255], [170, 0, 255], [255, 0, 255],
            [255, 0, 170], [255, 0, 85],
        ], np.uint8)
    cmap = np.zeros((n, 3), np.uint8)
    for i in range(n):
        r = g = b = 0
        idx = i
        for j in range(7):
            r ^= ((idx >> 0) & 1) << (7 - j)
            g ^= ((idx >> 1) & 1) << (7 - j)
            b ^= ((idx >> 2) & 1) << (7 - j)
            idx >>= 3
        cmap[i] = (r, g, b)
    return cmap


def obtain_2d_cords(b_coor: Dict, resize_param=None, org_size=None,
                    affine: Optional[Dict] = None) -> Dict[str, np.ndarray]:
    """An OpenPose person dict -> {'body': (2, K) (y, x) coordinates},
    rescaled from org_size to resize_param and moved by the affine."""
    pose = b_coor["pose_keypoints_2d"]
    k = len(pose) // 3
    coor_x = [pose[3 * i] for i in range(k)]
    coor_y = [pose[3 * i + 1] for i in range(k)]
    return {"body": modify_coor(coor_x, coor_y, resize_param, org_size,
                                affine)}


def modify_coor(coor_x, coor_y, resize_param=None, org_size=None,
                affine=None) -> np.ndarray:
    """Rescale and move the joints that are not MISSING_VALUE. Only the
    affine truncates to int: without one the coordinates stay fractional."""
    coor_x = list(coor_x)
    coor_y = list(coor_y)
    out_size = org_size
    if resize_param is not None:
        if org_size is None:
            raise ValueError("modify_coor: resize_param needs org_size")
        for i in range(len(coor_x)):
            if coor_x[i] == MISSING_VALUE or coor_y[i] == MISSING_VALUE:
                continue
            coor_x[i] = coor_x[i] / org_size[1] * resize_param[1]
            coor_y[i] = coor_y[i] / org_size[0] * resize_param[0]
        out_size = resize_param
    if affine is not None:
        center = (out_size[0] * 0.5 + 0.5, out_size[1] * 0.5 + 0.5)
        m = forward_affine_matrix(center, affine["angle"], affine["shift"],
                                  affine["scale"])
        for i in range(len(coor_x)):
            if coor_x[i] == MISSING_VALUE or coor_y[i] == MISSING_VALUE:
                continue
            p = m @ np.array([coor_x[i], coor_y[i], 1.0])
            coor_y[i] = int(p[1])
            coor_x[i] = int(p[0])
    return np.array([coor_y, coor_x])


def obtain_map(pose_joints: np.ndarray, im_size,
               sigma: float = 6.0) -> np.ndarray:
    """(2, K) coordinates -> (H, W, K) float32 Gaussian heatmaps, zero for a
    missing joint."""
    H, W = im_size
    K = pose_joints.shape[1]
    result = np.zeros((H, W, K), np.float32)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    for i in range(K):
        y, x = pose_joints[0, i], pose_joints[1, i]
        if x == MISSING_VALUE or y == MISSING_VALUE:
            continue
        result[..., i] = np.exp(-((yy - y) ** 2 + (xx - x) ** 2)
                                / (2 * sigma**2))
    return result


def draw_joint(colors: np.ndarray, pose_joints: np.ndarray,
               joint_line_list, radius: int = 2) -> np.ndarray:
    """White anti-aliased limb lines, each on its own canvas and copied in
    where it is not 0, then a filled disk of each joint's colour."""
    im_size = colors.shape[:2]
    pts = pose_joints.astype(int)
    for f, t in joint_line_list:
        if (pts[0, f] == MISSING_VALUE or pts[1, f] == MISSING_VALUE
                or pts[0, t] == MISSING_VALUE or pts[1, t] == MISSING_VALUE):
            continue
        line = np.zeros(im_size, np.uint8)
        line_aa(line, (pts[1, f], pts[0, f]), (pts[1, t], pts[0, t]), 255)
        sel = line > 0
        colors[sel] = line[sel][:, None]
    cmap = labelcolormap(pts.shape[1])
    for i in range(pts.shape[1]):
        if pts[0, i] == MISSING_VALUE or pts[1, i] == MISSING_VALUE:
            continue
        circle_filled(colors, (int(pts[1, i]), int(pts[0, i])), radius,
                      tuple(int(c) for c in cmap[i]))
    return colors


def openpose18_to_coco17(pose_18: np.ndarray) -> np.ndarray:
    out = np.zeros((2, 17), pose_18.dtype)
    for i, key in enumerate(COCO_17):
        out[:, i] = pose_18[:, OPENPOSE_18[key]]
    return out


def openpose25_to_coco17(pose_25: np.ndarray) -> np.ndarray:
    out = np.zeros((2, 17), pose_25.dtype)
    for i, key in enumerate(COCO_17):
        out[:, i] = pose_25[:, OPENPOSE_25[key]]
    return out


_FORMS = {
    "openpose_25": (25, LIMB_SEQ_25),
    "openpose_18": (18, LIMB_SEQ_18),
    "human36m_17": (17, LIMB_SEQ_HUMAN36M_17),
    "COCO_17": (17, LIMB_SEQ_COCO_17),
}


class tensor2skeleton:
    """Normalised keypoints (2K, T) in [-1, 1], [y..., x...] rows -> one
    uint8 (H, W, 3) render a frame (gfla_tpu/data/openpose_utils.py:
    197-235, the original's openpose_utils.py:282-358): draw_joint at
    radius 3 on black by default, or the limbs 2 pixels thick and the
    joints' outlines on white with `spatial_draw`. The pixel coordinates
    are clipped to [0, 255] whatever the image size, as in gfla_tpu."""

    def __init__(self, image_size=(256, 256), spatial_draw: bool = False):
        self.image_size = tuple(image_size)
        self.spatial_draw = spatial_draw

    def __call__(self, tensor, kp_form: str = "openpose_18"
                 ) -> List[np.ndarray]:
        coors = np.asarray(tensor)
        if coors.ndim == 3:
            coors = coors[0]
        h, w = self.image_size
        coors = np.clip(((coors + 1) / 2 * w).astype(int), 0, 255)
        n_kp, limbs = _FORMS[kp_form]
        out = []
        for i in range(coors.shape[1]):
            coor = coors[:, i].reshape(-1, n_kp)[0:2]
            if self.spatial_draw:
                out.append(self._spatial_draw(coor, limbs, 3))
            else:
                colors = np.zeros(self.image_size + (3,), np.uint8)
                out.append(draw_joint(colors, coor, limbs, 3))
        return out

    def _spatial_draw(self, pts, limbs, radius,
                      line_color=(118, 214, 255), circle_color=(66, 115, 177)):
        H, W = self.image_size
        colors = np.full((H, W, 3), 255, np.uint8)
        mask = np.zeros((H, W), np.uint8)
        p = np.clip(pts.astype(int), 0, [[H - 1], [W - 1]])
        for f, t in limbs:
            line_thick(mask, (p[1, f], p[0, f]), (p[1, t], p[0, t]), 1, 2)
        colors[mask == 1] = line_color
        mask[:] = 0
        for i in range(p.shape[1]):
            circle_outline(mask, (p[1, i], p[0, i]), radius, 1)
        colors[mask == 1] = circle_color
        return colors
