"""Curves through facial keypoints, rasterised for the face dataset's edge
maps (numpy copy of gfla_tpu/data/keypoint2img.py:15-68): a quadratic (or
linear, for steep or few points) fit through 2-3 keypoints, sampled at
integer steps, and drawn with a brush of half-width bw.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _poly_fit(x: np.ndarray, y: np.ndarray, order: int) -> np.ndarray:
    with np.errstate(all="ignore"):
        coef = np.polyfit(x, y, order)
    return coef


def interp_points(x: np.ndarray, y: np.ndarray
                  ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """Interpolate a smooth curve through up to 3 points. Returns integer
    (curve_x, curve_y) samples, or (None, None) for degenerate input.

    Steep segments (|slope| > 1) are fitted as x(y) to stay dense.
    """
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if len(x) < 2:
        return None, None
    if abs(x[:-1] - x[1:]).max() < 0.05:
        # vertical line
        curve_y = np.linspace(y.min(), y.max(),
                              int(abs(y.max() - y.min())) + 2)
        curve_x = np.full_like(curve_y, x.mean())
        return curve_x.astype(int), curve_y.astype(int)

    steep = abs(np.diff(y)).max() > abs(np.diff(x)).max()
    if steep:
        order = 2 if len(np.unique(y)) >= 3 else 1
        coef = _poly_fit(y, x, order)
        curve_y = np.linspace(y[0], y[-1], int(abs(y[-1] - y[0])) + 2)
        curve_x = np.polyval(coef, curve_y)
    else:
        order = 2 if len(np.unique(x)) >= 3 else 1
        coef = _poly_fit(x, y, order)
        curve_x = np.linspace(x[0], x[-1], int(abs(x[-1] - x[0])) + 2)
        curve_y = np.polyval(coef, curve_x)
    return curve_x.astype(int), curve_y.astype(int)


def draw_edge(im: np.ndarray, curve_x, curve_y, bw: int = 1,
              color: int = 255) -> None:
    """Rasterize curve samples into `im` with brush half-width bw."""
    if curve_x is None:
        return
    h, w = im.shape[:2]
    for dx in range(-bw, bw + 1):
        for dy in range(-bw, bw + 1):
            xs = np.clip(curve_x + dx, 0, w - 1)
            ys = np.clip(curve_y + dy, 0, h - 1)
            im[ys, xs] = color

