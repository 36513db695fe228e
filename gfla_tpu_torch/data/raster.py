"""The drawing and image primitives that gfla_tpu's animation data takes
from OpenCV (gfla_tpu/data/openpose_utils.py:143-171,
animation_data.py:420-455), as the port's own code, which depends on no
cv2. Each gives OpenCV's pixels bit for bit (tests/test_torch_port_
raster.py holds them against cv2 on random and degenerate inputs).

- `line_aa`: `cv2.line(img, p0, p1, color, 1, cv2.LINE_AA)` on a uint8
  grey image: OpenCV's anti-aliased line walk in 16-bit fixed point, with
  its slope and filter tables and its end-point corrections, clipped to
  the image as OpenCV clips;
- `circle_filled`: `cv2.circle(img, c, r, color, -1)` (LINE_8): the
  midpoint circle's horizontal spans;
- `fill_poly`: `cv2.fillPoly(img, [pts], value)` (LINE_8) on integer
  points: the outline by 8-connected Bresenham lines, then the scan-line
  fill of OpenCV's active-edge list, which decides the pixels of
  self-intersecting and collinear polygons;
- `distance_l1`: `cv2.distanceTransform(mask, cv2.DIST_L1, 3)`: the exact
  city-block distance to the nearest zero pixel, the largest float32
  everywhere when there is none;
- `resize_nearest`: `cv2.resize(img, (W, H), interpolation=INTER_NEAREST)`;
- `canny_l1`: `cv2.Canny(grey, low, high)` (aperture 3, L1 magnitude) on
  torch tensors in integer arithmetic, batched, so that the host (CPU
  tensors) and the card run one function.
The first five are numpy and run in the loader's workers.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT

# OpenCV's anti-aliasing tables (drawing.cpp): the intensity correction by
# slope and the line's cross-section, in 1/256 units
SLOPE_CORR = (
    181, 181, 181, 182, 182, 183, 184, 185, 187, 188, 190, 192, 194, 196,
    198, 201, 203, 206, 209, 211, 214, 218, 221, 224, 227, 231, 235, 238,
    242, 246, 250, 254)
FILTER = (
    168, 177, 185, 194, 202, 210, 218, 224, 231, 236, 241, 246, 249, 252,
    254, 254, 254, 254, 252, 249, 246, 241, 236, 231, 224, 218, 210, 202,
    194, 185, 177, 168, 158, 149, 140, 131, 122, 114, 105, 97, 89, 82, 75,
    68, 62, 56, 50, 45, 40, 36, 32, 28, 25, 22, 19, 16, 14, 12, 11, 9, 8,
    7, 5, 5)


def _trunc_div(a: int, b: int) -> int:
    """C's integer division, rounding toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def clip_line(width: int, height: int, p1, p2):
    """OpenCV's clipLine on [0, width-1] x [0, height-1]: (inside, p1, p2),
    the ends moved onto the border. OpenCV moves them also on the way to
    finding that the segment misses the image, and callers read them."""
    right, bottom = width - 1, height - 1
    (x1, y1), (x2, y2) = p1, p2
    if width <= 0 or height <= 0:
        return False, (x1, y1), (x2, y2)

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _blend(img: np.ndarray, x: int, y: int, color: int, a: int) -> None:
    v = int(img[y, x])
    v += ((color - v) * a + 127) >> 8
    v += ((color - v) * a + 127) >> 8
    img[y, x] = v


def line_aa(img: np.ndarray, p0: Tuple[int, int], p1: Tuple[int, int],
            color: int) -> np.ndarray:
    """Draw OpenCV's 1-pixel anti-aliased line from p0 to p1 ((x, y)
    integers) into the uint8 (H, W) `img` in place; returns img."""
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"line_aa: want uint8 (H, W), got {img.dtype} "
                         f"{img.shape}")
    H, W = img.shape
    inside, (x1, y1), (x2, y2) = clip_line(
        W << XY_SHIFT, H << XY_SHIFT,
        (int(p0[0]) << XY_SHIFT, int(p0[1]) << XY_SHIFT),
        (int(p1[0]) << XY_SHIFT, int(p1[1]) << XY_SHIFT))
    if not inside:
        return img
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:  # walk along x, left to right
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = XY_ONE, _trunc_div(dy << XY_SHIFT, ax | 1)
        x2 += XY_ONE
        ecount = (x2 >> XY_SHIFT) - (x1 >> XY_SHIFT)
        j = -(x1 & (XY_ONE - 1))
        y1 += ((y_step * j) >> XY_SHIFT) + (XY_ONE >> 1)
        slope = (y_step >> (XY_SHIFT - 5)) & 0x3F
        slope ^= 0x3F if y_step < 0 else 0
        i = (x1 >> (XY_SHIFT - 7)) & 0x78
        j = (x2 >> (XY_SHIFT - 7)) & 0x78
    else:  # walk along y, top to bottom
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = _trunc_div(dx << XY_SHIFT, ay | 1), XY_ONE
        y2 += XY_ONE
        ecount = (y2 >> XY_SHIFT) - (y1 >> XY_SHIFT)
        j = -(y1 & (XY_ONE - 1))
        x1 += ((x_step * j) >> XY_SHIFT) + (XY_ONE >> 1)
        slope = (x_step >> (XY_SHIFT - 5)) & 0x3F
        slope ^= 0x3F if x_step < 0 else 0
        i = (y1 >> (XY_SHIFT - 7)) & 0x78
        j = (y2 >> (XY_SHIFT - 7)) & 0x78
    slope = 0x100 if slope & 0x20 else SLOPE_CORR[slope]
    t0 = slope << 7
    t1 = ((0x78 - i) | 4) * slope
    t2 = (j | 4) * slope
    ep = [0] * 9
    ep[8] = slope
    ep[1] = ep[3] = ((((j - i) & 0x78) | 4) * slope >> 8) & 0x1FF
    ep[2] = (t1 >> 8) & 0x1FF
    ep[4] = ((((j - i) + 0x80) | 4) * slope >> 8) & 0x1FF
    ep[5] = ((t1 + t0) >> 8) & 0x1FF
    ep[6] = (t2 >> 8) & 0x1FF
    ep[7] = ((t2 + t0) >> 8) & 0x1FF
    scount = 0
    if ax > ay:
        x, pos, step, size, across = x1 >> XY_SHIFT, y1, y_step, W, H
    else:
        x, pos, step, size, across = y1 >> XY_SHIFT, x1, x_step, H, W
    while ecount >= 0:
        if 0 <= x < size:
            c = (pos >> XY_SHIFT) - 1
            corr = ep[(((scount >= 2) + 1) & (scount | 2)) * 3
                      + (((ecount >= 2) + 1) & (ecount | 2))]
            dist = (pos >> (XY_SHIFT - 5)) & 31
            for k, f in enumerate((FILTER[dist + 32], FILTER[dist],
                                   FILTER[63 - dist])):
                if 0 <= c + k < across:
                    a = (corr * f >> 8) & 0xFF
                    if ax > ay:
                        _blend(img, x, c + k, color, a)
                    else:
                        _blend(img, c + k, x, color, a)
        x += 1
        pos += step
        scount += 1
        ecount -= 1
    return img


def circle_filled(img: np.ndarray, center: Tuple[int, int], radius: int,
                  color) -> np.ndarray:
    """cv2.circle(img, center, radius, color, -1) with LINE_8, in place, on
    a uint8 (H, W) or (H, W, C) image; center is (x, y)."""
    H, W = img.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1

    def span(y, xa, xb):
        if 0 <= y < H:
            xa, xb = max(xa, 0), min(xb, W - 1)
            if xa <= xb:
                img[y, xa:xb + 1] = color

    while dx >= dy:
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if x11 < W and x12 >= 0 and cy - dx < H and cy + dx >= 0:
            span(cy - dy, x11, x12)
            span(cy + dy, x11, x12)
            if x21 < W and x22 >= 0:
                span(cy - dx, x21, x22)
                span(cy + dx, x21, x22)
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return img


def line8(img: np.ndarray, p0: Tuple[int, int], p1: Tuple[int, int],
          value) -> np.ndarray:
    """OpenCV's 8-connected line (LineIterator, left to right), clipped to
    the image, in place; p0 and p1 are (x, y)."""
    H, W = img.shape[:2]
    (x1, y1), (x2, y2) = p0, p1
    if not (0 <= x1 < W and 0 <= x2 < W and 0 <= y1 < H and 0 <= y2 < H):
        inside, (x1, y1), (x2, y2) = clip_line(W, H, (x1, y1), (x2, y2))
        if not inside:
            return img
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        dx, dy = -dx, -dy
        x1, y1 = x2, y2
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - (dy + dy)
    plus_delta, minus_delta = dx + dx, -(dy + dy)
    x, y = x1, y1
    for _ in range(dx + 1):
        img[y, x] = value
        if err < 0:  # a step along both axes
            err += minus_delta + plus_delta
            x, y = x + sx, y + sy
        else:
            err += minus_delta
            if vert:
                y += sy
            else:
                x += sx
    return img


def fill_poly(img: np.ndarray, pts, value) -> np.ndarray:
    """cv2.fillPoly(img, [pts], value) with LINE_8 on int32 (N, 2) (x, y)
    points, in place, on a uint8 (H, W) image."""
    pts = np.asarray(pts, np.int64).reshape(-1, 2).tolist()
    H, W = img.shape[:2]
    edges = []
    x0, y0 = pts[-1]
    for x1, y1 in pts:
        line8(img, (x0, y0), (x1, y1), value)
        c0x, c0y, c1x, c1y = x0 << XY_SHIFT, y0, x1 << XY_SHIFT, y1
        if not (0 <= x0 < W and 0 <= x1 < W and 0 <= y0 < H
                and 0 <= y1 < H):
            _, (t0x, t0y), (t1x, t1y) = clip_line(W, H, (x0, y0), (x1, y1))
            c0x, c1x = t0x << XY_SHIFT, t1x << XY_SHIFT
            if t0y != t1y:
                c0y, c1y = t0y, t1y
        if y0 != y1:
            edx = _trunc_div(c1x - c0x, c1y - c0y)
            if y0 < y1:
                edges.append([y0, y1, c0x + (y0 - c0y) * edx, edx])
            else:
                edges.append([y1, y0, c1x + (y1 - c1y) * edx, edx])
        x0, y0 = x1, y1
    _fill_edges(img, edges, value)
    return img


def _fill_edges(img: np.ndarray, edges, value) -> None:
    """OpenCV's FillEdgeCollection: edges [y0, y1, x (fixed point), dx]
    sorted by (y0, x, dx), an active list kept sorted by x, and each pair of
    neighbours in it filling the span between them on each row."""
    H, W = img.shape[:2]
    if len(edges) < 2:
        return
    y_min = min(e[0] for e in edges)
    y_max = max(e[1] for e in edges)
    xs = [e[2] for e in edges] + [e[2] + (e[1] - e[0]) * e[3] for e in edges]
    if y_max < 0 or y_min >= H or max(xs) < 0 or min(xs) >= (W << XY_SHIFT):
        return
    edges = sorted(edges, key=lambda e: (e[0], e[2], e[3]))
    y_max = min(y_max, H)
    n, i = len(edges), 0
    active = []
    for y in range(edges[0][0], y_max):
        # one walk down the active list, new edges merged in where their x
        # is at most the next active edge's; each second edge met closes a
        # span that opened at the one before it
        walked, prev, draw, a = [], None, False, 0
        while a < len(active) or (i < n and edges[i][0] == y):
            last = active[a] if a < len(active) else None
            if last is not None and last[1] == y:  # the edge ends here
                a += 1
                continue
            if last is not None and (i == n or edges[i][0] > y
                                     or last[2] < edges[i][2]):
                edge = last
                a += 1
            else:
                edge = edges[i]
                i += 1
            walked.append(edge)
            if draw:
                if y >= 0:
                    xa, xb = sorted((prev[2], edge[2]))
                    xa, xb = (xa + XY_ONE - 1) >> XY_SHIFT, xb >> XY_SHIFT
                    if xa < W and xb >= 0:
                        img[y, max(xa, 0):min(xb, W - 1) + 1] = value
                prev[2] += prev[3]
                edge[2] += edge[3]
            draw = not draw
            prev = edge
        active = sorted(walked, key=lambda e: e[2])  # stable, as OpenCV's


NO_ZERO_DISTANCE = np.finfo(np.float32).max


def _l1_pass(d: np.ndarray, axis: int) -> np.ndarray:
    """min over j of d[j] + |i - j| along `axis`: a running minimum of
    d[j] - j from the left and of d[j] + j from the right."""
    n = d.shape[axis]
    idx = np.arange(n).reshape([-1 if a == axis else 1
                                for a in range(d.ndim)])
    left = np.minimum.accumulate(d - idx, axis=axis) + idx
    right = np.flip(np.minimum.accumulate(np.flip(d + idx, axis), axis=axis),
                    axis) - idx
    return np.minimum(left, right)


def distance_l1(mask: np.ndarray) -> np.ndarray:
    """cv2.distanceTransform(mask, cv2.DIST_L1, 3): float32 city-block
    distance of each pixel to the nearest zero pixel of the uint8 (H, W)
    mask; NO_ZERO_DISTANCE everywhere when it has none."""
    zero = mask == 0
    if not zero.any():
        return np.full(mask.shape, NO_ZERO_DISTANCE, np.float32)
    big = mask.shape[0] + mask.shape[1]
    d = np.where(zero, 0, big).astype(np.int32)
    return _l1_pass(_l1_pass(d, 1), 0).astype(np.float32)


def resize_nearest(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, size, interpolation=cv2.INTER_NEAREST), size = (W,
    H): source index floor(i * (1 / (dst / src))) in float64, clipped."""
    W, H = size
    h, w = img.shape[:2]
    sx = np.minimum(np.floor(np.arange(W) * (1.0 / (W / w))).astype(np.int64),
                    w - 1)
    sy = np.minimum(np.floor(np.arange(H) * (1.0 / (H / h))).astype(np.int64),
                    h - 1)
    return img[sy[:, None], sx[None, :]]


CANNY_SHIFT = 15
TG22 = int(0.4142135623730950488016887242097 * (1 << CANNY_SHIFT) + 0.5)


def canny_l1(grey: torch.Tensor, low: float, high: float) -> torch.Tensor:
    """cv2.Canny(grey, low, high) with aperture 3 and the L1 magnitude on
    uint8 (..., H, W) grey images, on their device -> bool edges (..., H,
    W). OpenCV's steps: Sobel with the border replicated; |dx| + |dy|;
    non-maximum suppression in four directions (tan 22.5 in 15-bit fixed
    point), where a pixel must exceed its neighbour on one side and be at
    least its neighbour on the other (horizontally and vertically, and exceed
    both diagonally), the magnitude being 0 outside the image; candidates
    above floor(low), seeds above floor(high); the edges are the candidates
    8-connected to a seed through candidates."""
    low, high = int(np.floor(low)), int(np.floor(high))
    if low > high:
        low, high = high, low
    lead, (H, W) = grey.shape[:-2], grey.shape[-2:]
    g = grey.reshape(-1, 1, H, W).to(torch.int32)
    p = torch.nn.functional.pad(g.float(), (1, 1, 1, 1),
                                mode="replicate").to(torch.int32)

    def at(dy, dx):
        return p[..., 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]

    sx = (at(-1, 1) + 2 * at(0, 1) + at(1, 1)
          - at(-1, -1) - 2 * at(0, -1) - at(1, -1))
    sy = (at(1, -1) + 2 * at(1, 0) + at(1, 1)
          - at(-1, -1) - 2 * at(-1, 0) - at(-1, 1))
    mag = sx.abs() + sy.abs()
    m = torch.nn.functional.pad(mag, (1, 1, 1, 1))

    def nb(dy, dx):
        return m[..., 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]

    ax = sx.abs().to(torch.int64)
    ay = sy.abs().to(torch.int64) << CANNY_SHIFT
    tg22x = ax * TG22
    tg67x = tg22x + (ax << (CANNY_SHIFT + 1))
    horizontal = ay < tg22x
    vertical = ~horizontal & (ay > tg67x)
    same_sign = (sx < 0) == (sy < 0)
    keep_h = (mag > nb(0, -1)) & (mag >= nb(0, 1))
    keep_v = (mag > nb(-1, 0)) & (mag >= nb(1, 0))
    keep_d = torch.where(same_sign,
                         (mag > nb(-1, -1)) & (mag > nb(1, 1)),
                         (mag > nb(-1, 1)) & (mag > nb(1, -1)))
    keep = torch.where(horizontal, keep_h,
                       torch.where(vertical, keep_v, keep_d))
    candidate = keep & (mag > low)
    edges = candidate & (mag > high)
    while True:  # hysteresis: grow the seeds through the candidates
        grown = candidate & (torch.nn.functional.max_pool2d(
            edges.to(torch.float32), 3, 1, 1) > 0)
        if torch.equal(grown, edges):
            break
        edges = grown
    return edges.reshape(*lead, H, W)
