"""The port's copies of the cv2 and PIL calls of gfla_tpu's animation data
(gfla_tpu_torch/data/raster.py, data/resample.py, data/image_io.py)
against cv2 and PIL themselves, bitwise, on the CPU.

Each case draws its inputs from a numpy RandomState of its own:
- line_aa (cv2.line, LINE_AA): random segments inside and far outside the
  image, points, and horizontal, vertical and diagonal ones;
- circle_filled (cv2.circle, -1): radii 0-6, centres inside, on the edge
  and off the image, grey and colour; circle_outline (cv2.circle, 1) the
  same with radii 0-8;
- line_thick (cv2.line, thickness 2-9, LINE_8): segments inside and far
  outside the image, short ones, points, horizontal and vertical ones;
- tensor2skeleton (gfla_tpu's, on cv2), spatial_draw and the default route, on random
  normalised Human3.6M-17 and OpenPose-18 sequences, at 256x256 and at
  64x64, where the coordinates are clipped to 255 as gfla_tpu clips them;
- fill_poly (cv2.fillPoly): random, self-intersecting, collinear,
  repeated-point and off-image polygons, two points to thirteen;
- distance_l1 (cv2.distanceTransform, DIST_L1, 3): sparse and dense edge
  maps, one with no zero pixel;
- resize_nearest (cv2.resize, INTER_NEAREST): up, down and mixed sizes that
  are no multiples of each other;
- canny_l1 (cv2.Canny 100/200): random greys, flat and step images, and
  steps whose Sobel magnitude ties 100 or 200 exactly;
- pil_resize's bicubic and convert_l (PIL's resize(BICUBIC) and
  convert("L")): a downscale 320x240 -> 256x256, the copy at the stored
  size, and random sizes; jpeg_size against Image.open(...).size.
"""

import io
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from gfla_tpu_torch.data import raster
from gfla_tpu_torch.data.image_io import jpeg_size
from gfla_tpu_torch.data.resample import convert_l, pil_resize

FIXTURES = Path(__file__).resolve().parent / "fixtures"
N = 120  # draws a case


def _equal(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert np.array_equal(got, want), (
        f"{what}: {np.count_nonzero(got != want)} values differ, first at "
        f"{np.argwhere(got != want)[0].tolist()}")


def _segment(rng, kind, H, W):
    if kind == "inside":
        return ((int(rng.randint(W)), int(rng.randint(H))),
                (int(rng.randint(W)), int(rng.randint(H))))
    if kind == "outside":
        return tuple((int(rng.randint(-3 * W, 4 * W)),
                      int(rng.randint(-3 * H, 4 * H))) for _ in range(2))
    x, y = int(rng.randint(W)), int(rng.randint(H))
    d = int(rng.randint(-40, 41))
    return {"point": ((x, y), (x, y)), "horizontal": ((x, y), (x + d, y)),
            "vertical": ((x, y), (x, y + d)),
            "diagonal": ((x, y), (x + d, y - d))}[kind]


@pytest.mark.parametrize("kind", ["inside", "outside", "point", "horizontal",
                                  "vertical", "diagonal"])
def test_line_aa_is_cv2s(kind):
    rng = np.random.RandomState(sum(map(ord, kind)))
    for i in range(N):
        H, W = rng.randint(1, 90, 2)
        p0, p1 = _segment(rng, kind, H, W)
        want = rng.randint(0, 40, (H, W)).astype(np.uint8)
        got = want.copy()
        color = int(rng.randint(1, 256))
        cv2.line(want, p0, p1, color, 1, cv2.LINE_AA)
        raster.line_aa(got, p0, p1, color)
        _equal(got, want, f"{kind} {i}: {p0} -> {p1} in {H}x{W}")


@pytest.mark.parametrize("channels", [0, 3], ids=["grey", "colour"])
def test_circle_filled_is_cv2s(channels):
    rng = np.random.RandomState(channels)
    for i in range(N):
        H, W = rng.randint(1, 40, 2)
        c = (int(rng.randint(-8, W + 8)), int(rng.randint(-8, H + 8)))
        r = int(rng.randint(0, 7))
        shape = (H, W, channels) if channels else (H, W)
        color = tuple(int(v) for v in rng.randint(1, 256, max(channels, 1)))
        want = np.zeros(shape, np.uint8)
        got = want.copy()
        cv2.circle(want, c, r, color if channels else color[0], -1)
        raster.circle_filled(got, c, r, color if channels else color[0])
        _equal(got, want, f"{i}: centre {c} radius {r} in {H}x{W}")


@pytest.mark.parametrize("channels", [0, 3], ids=["grey", "colour"])
def test_circle_outline_is_cv2s(channels):
    rng = np.random.RandomState(10 + channels)
    for i in range(N):
        H, W = rng.randint(1, 40, 2)
        c = (int(rng.randint(-10, W + 10)), int(rng.randint(-10, H + 10)))
        r = int(rng.randint(0, 9))
        shape = (H, W, channels) if channels else (H, W)
        color = tuple(int(v) for v in rng.randint(1, 256, max(channels, 1)))
        want = rng.randint(0, 3, shape).astype(np.uint8)
        got = want.copy()
        cv2.circle(want, c, r, color if channels else color[0], 1)
        raster.circle_outline(got, c, r, color if channels else color[0])
        _equal(got, want, f"{i}: centre {c} radius {r} in {H}x{W}")


@pytest.mark.parametrize("kind", ["inside", "outside", "point", "horizontal",
                                  "vertical", "diagonal"])
def test_line_thick_is_cv2s(kind):
    rng = np.random.RandomState(20 + len(kind))
    for i in range(N):
        H, W = rng.randint(1, 70, 2)
        p0, p1 = _segment(rng, kind, H, W)
        if kind == "point" and i % 2:  # a step of a pixel or two
            p1 = (p1[0] + int(rng.randint(-2, 3)),
                  p1[1] + int(rng.randint(-2, 3)))
        thickness = 2 if i % 3 else int(rng.randint(3, 10))
        want = rng.randint(0, 2, (H, W)).astype(np.uint8) * 7
        got = want.copy()
        cv2.line(want, p0, p1, 1, thickness)
        raster.line_thick(got, p0, p1, 1, thickness)
        _equal(got, want, f"{kind} {i}: {p0} -> {p1} x{thickness} in "
                          f"{H}x{W}")


@pytest.mark.parametrize("form,size", [("human36m_17", 256),
                                       ("human36m_17", 64),
                                       ("openpose_18", 256)])
def test_tensor2skeleton_spatial_draw_is_gfla_tpus(form, size):
    from gfla_tpu.data.openpose_utils import tensor2skeleton as jax_t2s
    from gfla_tpu_torch.data.openpose_utils import tensor2skeleton

    rng = np.random.RandomState(size)
    k = 17 if form == "human36m_17" else 18
    kp = rng.uniform(-1.1, 1.1, (2 * k, 6)).astype(np.float32)
    for spatial in (True, False):
        got = tensor2skeleton((size, size), spatial_draw=spatial)(kp, form)
        want = jax_t2s((size, size), spatial_draw=spatial)(kp[None], form)
        assert len(got) == len(want) == 6
        for t, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, f"{form} {size} spatial={spatial} frame {t}")


def _polygon(rng, kind, H, W):
    k = rng.randint(2, 14)
    if kind == "inside":
        return np.stack([rng.randint(0, W, k), rng.randint(0, H, k)], 1)
    if kind == "off-image":
        return rng.randint(-60, 150, (k, 2))
    if kind == "collinear":
        t = rng.randint(-20, 20, k)
        return np.stack([5 + 2 * t, 7 + 3 * t], 1)
    if kind == "repeated":
        return rng.randint(0, 40, (3, 2))[rng.randint(0, 3, k)]
    # landmark-like: float points a little past the frame, truncated
    return (rng.rand(k, 2) * [W, H] * 1.2 - 3).astype(np.int32)


@pytest.mark.parametrize("kind", ["inside", "off-image", "collinear",
                                  "repeated", "truncated"])
def test_fill_poly_is_cv2s(kind):
    rng = np.random.RandomState(sum(map(ord, kind)))
    for i in range(N):
        H, W = rng.randint(1, 90, 2)
        pts = _polygon(rng, kind, H, W).astype(np.int32)
        value = int(rng.randint(1, 7))
        want = np.zeros((H, W), np.uint8)
        got = want.copy()
        cv2.fillPoly(want, [pts], value)
        raster.fill_poly(got, pts, value)
        _equal(got, want, f"{kind} {i}: {pts.tolist()} in {H}x{W}")


@pytest.mark.parametrize("density", [0.0, 0.001, 0.02, 0.3, 1.0])
def test_distance_l1_is_cv2s(density):
    rng = np.random.RandomState(int(density * 1000))
    for i in range(N // 4):
        H, W = rng.randint(1, 120, 2)
        edge = (rng.rand(H, W) < density).astype(np.uint8) * 255
        mask = 255 - edge
        want = cv2.distanceTransform(mask, cv2.DIST_L1, 3)
        _equal(raster.distance_l1(mask), want, f"{i}: {H}x{W}")


@pytest.mark.parametrize("direction", ["up", "down", "mixed"])
def test_resize_nearest_is_cv2s(direction):
    rng = np.random.RandomState(len(direction))
    for i in range(N):
        h, w = rng.randint(1, 300, 2)
        H, W = {"up": lambda: rng.randint(300, 700, 2),
                "down": lambda: rng.randint(1, 300, 2) // 2 + 1,
                "mixed": lambda: (rng.randint(1, 300), rng.randint(300, 600))
                }[direction]()
        img = rng.randint(0, 7, (h, w)).astype(np.uint8)
        want = cv2.resize(img, (int(W), int(H)),
                          interpolation=cv2.INTER_NEAREST)
        _equal(raster.resize_nearest(img, (int(W), int(H))), want,
               f"{i}: {h}x{w} -> {H}x{W}")


def _grey(rng, kind, H, W):
    if kind == "random":
        return rng.randint(0, 256, (H, W))
    if kind == "flat":
        return np.full((H, W), rng.randint(256))
    if kind == "steps":
        g = np.zeros((H, W))
        g[:, rng.randint(W):] = rng.randint(256)
        g[rng.randint(H):] += rng.randint(0, 100)
        return g
    # Sobel of a step of 25 (50) is 100 (200): magnitudes that tie the
    # thresholds, and near-ties one level away
    step = rng.choice([25, 50])
    return (rng.rand(H, W) < 0.5) * step + rng.randint(0, 2, (H, W)) \
        + 40 * (rng.rand(H, W) < 0.05)


@pytest.mark.parametrize("kind", ["random", "flat", "steps", "ties"])
def test_canny_is_cv2s(kind):
    rng = np.random.RandomState(len(kind))
    greys = [np.clip(_grey(rng, kind, *rng.randint(3, 90, 2)), 0, 255)
             .astype(np.uint8) for _ in range(N // 2)]
    for i, g in enumerate(greys):
        want = cv2.Canny(g, 100, 200) > 0
        got = raster.canny_l1(torch.from_numpy(g), 100, 200).numpy()
        _equal(got, want, f"{kind} {i}: {g.shape}")
    # batched: one call over same-size images gives each one's edges
    batch = np.stack([np.clip(_grey(rng, kind, 40, 50), 0, 255)
                      .astype(np.uint8) for _ in range(4)])
    got = raster.canny_l1(torch.from_numpy(batch), 100, 200).numpy()
    _equal(got, np.stack([cv2.Canny(g, 100, 200) > 0 for g in batch]),
           f"{kind} batched")


@pytest.mark.parametrize("src,dst", [((240, 320), (256, 256)),
                                     ((256, 256), (256, 256)),
                                     ("random", None)],
                         ids=["320x240-to-256", "same-size", "random"])
def test_grey_and_bicubic_are_pils(src, dst):
    rng = np.random.RandomState(5)
    sizes = [(src, dst)] if dst else [
        (tuple(rng.randint(1, 200, 2)), tuple(rng.randint(1, 200, 2)))
        for _ in range(N // 4)]
    for (h, w), (H, W) in sizes:
        rgb = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        rgb[: h // 2] = np.where(rng.rand(h // 2, w, 1) < 0.5, 0, 255)
        pil = Image.fromarray(rgb).convert("L")
        grey = convert_l(torch.from_numpy(rgb))
        _equal(grey.numpy(), np.asarray(pil), f"convert L {h}x{w}")
        want = np.asarray(pil.resize((int(W), int(H)), Image.BICUBIC))
        got = pil_resize(grey[..., None], (int(H), int(W)), "bicubic")
        _equal(got[..., 0].numpy(), want, f"bicubic {h}x{w} -> {H}x{W}")


def test_jpeg_size_is_pils(tmp_path):
    rng = np.random.RandomState(9)
    datas = [(FIXTURES / "pil_q75_96x64.jpg").read_bytes()]
    for h, w, mode, progressive in ((1, 1, "RGB", False),
                                    (240, 320, "RGB", True),
                                    (7, 999, "L", False),
                                    (256, 256, "RGB", False)):
        shape = (h, w, 3) if mode == "RGB" else (h, w)
        buf = io.BytesIO()
        Image.fromarray(rng.randint(0, 256, shape).astype(np.uint8)).save(
            buf, format="JPEG", quality=75, progressive=progressive)
        datas.append(buf.getvalue())
    for data in datas:
        with Image.open(io.BytesIO(data)) as img:
            w, h = img.size
        assert jpeg_size(data) == (h, w)
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg_size(b"\x89PNG\r\n\x1a\n" + bytes(16))


def test_face_fixture_decodes_to_its_array():
    """chip_smoke.py holds nvJPEG's Canny edges against PIL's on this
    fixture: its .npy is PIL's decode of its .jpg."""
    from gfla_tpu_torch.data.image_io import decode_jpeg_batch

    data = np.fromfile(FIXTURES / "face_q75_240x320.jpg", np.uint8)
    (img,) = decode_jpeg_batch([data], "cpu", ["face_q75_240x320.jpg"])
    _equal(img.numpy(), np.load(FIXTURES / "face_q75_240x320.npy"),
           "face fixture")
