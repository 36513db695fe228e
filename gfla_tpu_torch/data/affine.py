"""Random affine augmentation of the pose and dance datasets (numpy twin of
gfla_tpu/data/affine.py:17-66): the draws, in gfla_tpu's order from the
dataset's RandomState, and the inverse and forward matrices. The warps
themselves are data/resample.py, on tensors."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np


def random_affine_params(rng: np.random.RandomState,
                         angle: Optional[Sequence[float]],
                         shift: Optional[Sequence[float]],
                         scale: Optional[Sequence[float]]):
    """(angle, (tx, ty), scale): angle, then scale, then the two shifts,
    each drawn only when its range is set."""
    a = rng.uniform(angle[0], angle[1]) if angle else 0.0
    s = rng.uniform(scale[0], scale[1]) if scale else 1.0
    if shift:
        t = (rng.uniform(shift[0], shift[1]), rng.uniform(shift[0], shift[1]))
    else:
        t = (0.0, 0.0)
    return a, t, s


def inverse_affine_matrix(center, angle, translate, scale) -> list:
    """The 2x3 map from an output pixel to the input, as a flat list:
    C RSS^-1 C^-1 T^-1 (torchvision's convention, no shear)."""
    angle = math.radians(angle)
    scale = 1.0 / scale
    matrix = [math.cos(angle), math.sin(angle), 0,
              -math.sin(angle), math.cos(angle), 0]
    matrix = [scale * m for m in matrix]
    matrix[2] += matrix[0] * (-center[0] - translate[0]) + \
        matrix[1] * (-center[1] - translate[1])
    matrix[5] += matrix[3] * (-center[0] - translate[0]) + \
        matrix[4] * (-center[1] - translate[1])
    matrix[2] += center[0]
    matrix[5] += center[1]
    return matrix


def image_inverse(size, affine) -> np.ndarray:
    """The (2, 3) float64 inverse map of an affine draw (a dict of angle,
    shift and scale, or None: the identity) for an image of `size` (H, W),
    about its centre (W * 0.5 + 0.5, H * 0.5 + 0.5), as gfla_tpu's
    `apply_affine` builds it for PIL's transform of the resized image."""
    if affine is None:
        return np.array([[1, 0, 0], [0, 1, 0]], np.float64)
    H, W = size
    return np.asarray(inverse_affine_matrix(
        (W * 0.5 + 0.5, H * 0.5 + 0.5), affine["angle"], affine["shift"],
        affine["scale"]), np.float64).reshape(2, 3)


def forward_affine_matrix(center, angle, translate, scale) -> np.ndarray:
    """The forward 3x3 matrix that moves the keypoints."""
    inv = np.array(inverse_affine_matrix(center, angle, translate, scale))
    m = np.vstack([inv.reshape(2, 3), [0, 0, 1]])
    return np.linalg.inv(m)
